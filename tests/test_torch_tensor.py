"""The port's eager Tensor against the reference's on the CPU: default
dtypes (the reference runs without x64: ints are int32, floats
float32), stop_gradient, grads over two backward() calls, clear_grad,
retain_grads, hooks, detach, the Python operators, indexing, in-place
methods on a tensor inside a graph and on a leaf that requires a grad,
places and set_device. Values agree within 1e-6 (rtol = atol, f32)."""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import device as tdevice
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-6, atol=1e-6)
rng = np.random.default_rng(3)
X = rng.standard_normal((3, 4)).astype(np.float32)
Y = rng.standard_normal((3, 4)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _name(dtype):
    """A dtype's name in either package."""
    return getattr(dtype, "name", None) or str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("data,dtype", [
    (np.array([1, 2]), None), (np.array([1.5, 2.0]), None), ([1, 2], None),
    ([1.0, 2.0], None), (3, None), (2.5, None), (True, None),
    (np.array([1, 2], np.int64), None), (np.array([1, 2]), "int64"),
    (np.array([1, 2]), "float64"), (np.array([1, 2]), "float16"),
    (np.array([1.0, 2.0]), "bfloat16"), (np.array([1, 0]), "bool"),
    (np.array([1, 2], np.uint8), None), (np.array([1, 2], np.int8), None),
    (np.array([1.0], np.float16), None),
], ids=lambda v: repr(v))
def test_to_tensor_dtypes_match_reference(data, dtype):
    """int32 and float32 by default (JAX without x64): 64-bit requests
    narrow to 32-bit types in both packages."""
    got = ptt.to_tensor(data, dtype=dtype)
    want = pt.to_tensor(data, dtype=dtype)
    assert _name(got.dtype) == _name(want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got.numpy(), np.float64),
                                  np.asarray(want.numpy(), np.float64))


def test_tensor_metadata_and_interop():
    t = ptt.to_tensor(X)
    assert t.shape == [3, 4] and t.ndim == 2 and t.size == 12
    assert t.stop_gradient and t.is_leaf
    assert t.place == ptt.CPUPlace() and t.place.is_cpu_place()
    np.testing.assert_array_equal(np.asarray(t), X)
    assert t.tolist() == X.tolist()
    assert float(ptt.to_tensor(2.5)) == 2.5 and int(ptt.to_tensor(3)) == 3
    assert ptt.to_tensor(X)[0, 1].item() == X[0, 1]
    assert len(t) == 3 and [r.shape for r in t] == [[4]] * 3
    # a copy: writing to the source leaves the Tensor as it was
    src = X.copy()
    t2 = ptt.to_tensor(src)
    src[0, 0] = 99.0
    assert float(t2[0, 0]) == X[0, 0]
    back = pickle.loads(pickle.dumps(ptt.to_tensor(X, stop_gradient=False)))
    np.testing.assert_array_equal(back.numpy(), X)
    assert not back.stop_gradient
    bf = ptt.to_tensor(X, dtype="bfloat16")
    np.testing.assert_array_equal(
        np.asarray(bf.numpy(), np.float32),
        np.asarray(pt.to_tensor(X, dtype="bfloat16").numpy(), np.float32))


def test_stop_gradient_default_and_setter():
    for P in (ptt, pt):
        x = P.to_tensor(X)
        assert x.stop_gradient
        y = x * 2
        assert y.stop_gradient
        x.stop_gradient = False
        z = x * 2
        assert not z.stop_gradient
        z.stop_gradient = True
        assert (z * 2).stop_gradient
        i = P.to_tensor(np.array([1, 2]), stop_gradient=False)
        assert not i.stop_gradient
        assert (i * 2).stop_gradient, P.__name__   # an int result


def _grads(P):
    x = P.to_tensor(X, stop_gradient=False)
    y = P.to_tensor(Y, stop_gradient=False)
    (x * y).sum().backward()
    first = x.grad.numpy().copy()
    (x * x).sum().backward()
    acc = x.grad.numpy().copy()
    x.clear_grad()
    return first, acc, x.grad, y.grad.numpy()


def test_grad_accumulates_and_clear_grad_sets_none():
    got, want = _grads(ptt), _grads(pt)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert got[2] is None and want[2] is None
    np.testing.assert_allclose(got[3], want[3], **TOL)


def _retain_hooks_detach(P):
    x = P.to_tensor(X, stop_gradient=False)
    h = x * 3
    h.retain_grads()
    seen = []
    handle = x.register_hook(lambda g: seen.append(g.numpy().copy()))
    d = h.detach()
    assert d.stop_gradient
    out = (h * h + d).sum()
    out.backward()
    handle.remove()
    return h.grad.numpy(), x.grad.numpy(), np.asarray(seen)


def test_retain_grads_hooks_detach():
    for g, w in zip(_retain_hooks_detach(ptt), _retain_hooks_detach(pt)):
        np.testing.assert_allclose(g, w, **TOL)


def _operators(P):
    x, y = P.to_tensor(X), P.to_tensor(Y)
    i, j = P.to_tensor(np.array([7, -3, 5])), P.to_tensor(np.array([2, 2, 3]))
    outs = [x + y, x - y, x * y, x / (y * y + 1), x ** 2, -x, abs(x),
            x @ P.t(y), 2.0 + x, 3 - x, 2 * x, 1 / (x * x + 1), 2 ** x,
            x > y, x >= y, x < y, x <= y, x == x, x != y, i // j, i % j,
            i & j, i | j, i ^ j, ~i, x + 1, i + 1, i * 2.5, i / j,
            x.astype("int32"), x.astype("float16")]
    return [np.asarray(o.numpy()) for o in outs], [_name(o.dtype)
                                                   for o in outs]


def test_python_operators_match_reference():
    (got, gdt), (want, wdt) = _operators(ptt), _operators(pt)
    assert gdt == wdt
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=1e-3,
                                   atol=1e-6)


def _indexing(P):
    x = P.to_tensor(np.arange(60, dtype=np.float32).reshape(3, 4, 5))
    gets = [x[1], x[1:3, ::2], x[:, None, 0], x[..., -1], x[-1, 2, 3],
            x[P.to_tensor(np.array([2, 0]))], x[x > 30],
            x[[0, 2], [1, 3]]]
    y = P.to_tensor(np.zeros((4, 5), np.float32))
    y[1] = 2.0
    y[2:, 1] = P.to_tensor(np.array([5.0, 6.0], np.float32))
    y[y > 4] = -1.0
    y[0, 0] = 7
    return [np.asarray(g.numpy()) for g in gets] + [y.numpy()]


def test_indexing_get_set():
    for g, w in zip(_indexing(ptt), _indexing(pt)):
        np.testing.assert_array_equal(g, np.asarray(w))


def _inplace_in_graph(P):
    """In-place methods on a tensor inside a graph and on a leaf that
    requires a grad: both rebind, the grads reach the original leaf."""
    w = P.to_tensor(X, stop_gradient=False)
    h = w * 2
    s = h * h           # saves h for its backward
    h.add_(1.0)         # h is rebound, the saved h untouched
    h.scale_(3.0)
    h[0] = 0.0
    loss = s.sum() + (h * w).sum()
    loss.backward()
    g_first = w.grad.numpy().copy()
    v = P.to_tensor(Y, stop_gradient=False)
    v.multiply_(P.to_tensor(X))     # a leaf that requires a grad
    v.exp_()
    v.sum().backward()
    return [h.numpy(), g_first, v.numpy(), v.grad.numpy()]


def test_inplace_ops_on_tensors_in_a_graph():
    for g, w in zip(_inplace_in_graph(ptt), _inplace_in_graph(pt)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _inplace_unrecorded(P):
    w = P.to_tensor(X, stop_gradient=False)
    (w * 3).sum().backward()
    with P.no_grad():
        w.subtract_(w.grad * 0.5)
    w.clip_(-0.5, 0.5)
    z = P.to_tensor(X)
    z.zero_()
    f = P.to_tensor(X)
    f.fill_(2.5)
    c = P.to_tensor(X)
    c.cast_("int32")
    return [w.numpy(), w.grad.numpy(), np.asarray(w.stop_gradient),
            z.numpy(), f.numpy(), c.numpy()]


def test_inplace_ops_unrecorded_and_on_plain_tensors():
    for g, w in zip(_inplace_unrecorded(ptt), _inplace_unrecorded(pt)):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), **TOL)


def test_inplace_never_writes_storage_autograd_saved():
    """torch raises on a saved tensor written in place, the reference
    does not: the port's in-place methods rebind instead."""
    x = ptt.to_tensor(X, stop_gradient=False)
    before = x._data
    y = ptt.exp(x)               # saves its output
    y.add_(1.0)
    y.sqrt_()
    x.add_(1.0)                  # a leaf that requires a grad
    (y.sum() + x.sum()).backward()
    assert x._data is not before and x.grad is not None
    np.testing.assert_allclose(x.grad.numpy(), np.exp(X) * 0.5
                               / np.sqrt(np.exp(X) + 1) + 1, rtol=1e-5)


def test_set_value_writes_in_place_and_methods():
    for P in (ptt, pt):
        x = P.to_tensor(X, stop_gradient=False)
        x.set_value(Y)
        np.testing.assert_array_equal(x.numpy(), Y)
        assert not x.stop_gradient
        c = x.clone()
        (c * 2).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.full_like(X, 2.0))
        assert x.sum(axis=0).shape == [4]
        assert x.reshape([4, 3]).transpose([1, 0]).shape == [3, 4]
        assert x.mean().shape == []
    t = ptt.to_tensor(X)
    t.copy_(ptt.to_tensor(Y))
    assert t._data.data_ptr() == t._data.data_ptr()
    np.testing.assert_array_equal(t.numpy(), Y)


def test_places_and_set_device(monkeypatch):
    assert ptt.get_device() == "cpu:0"
    assert ptt.CUDAPlace(1) == ptt.Place("gpu", 1)
    assert ptt.CUDAPlace(0).is_gpu_place()
    assert not ptt.is_compiled_with_tpu() if hasattr(
        ptt, "is_compiled_with_tpu") else True
    assert ptt.device_count() == torch.cuda.device_count()
    t = ptt.to_tensor(X, place=ptt.CPUPlace())
    assert t.place == ptt.CPUPlace()
    assert t.cpu().place == ptt.CPUPlace()
    assert t.to("float16").dtype == torch.float16
    with pytest.raises(ValueError):
        ptt.set_device("tpu")
    # without a card, the default place raises until set_device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_current_place", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.to_tensor(X)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.set_device("gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.zeros([2])
    # a torch tensor keeps its device: no place is needed
    assert ptt.to_tensor(torch.ones(2)).place == ptt.CPUPlace()
    assert ptt.set_device("cpu") == ptt.CPUPlace()
    assert ptt.to_tensor(X).place == ptt.CPUPlace()
