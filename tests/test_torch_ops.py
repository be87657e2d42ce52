"""The port's registered ops against the reference's on the CPU: every
case of tests/eager_op_cases.py (the tables of test_ops_math.py and
test_ops_torch_oracle.py, the in-slice cases of test_ops_oracle_r3.py,
and a case for each op of the slice's OPS table) runs on both packages
from the same numpy inputs. Values must agree within the case's `tol`
(default 1e-6, rtol = atol: XLA and torch compute the same f32
functions with other kernels, a few ulps apart; the transcendental and
decomposition cases state 1e-4), dtypes and shapes exactly, and the
inputs' gradients through ``backward()`` within `grad_tol` (default
1e-5). An input an output does not reach has a grad of None in the port
(torch records no edge to it) and of zeros in the reference."""
import numpy as np
import pytest

import eager_op_cases as C
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import OPS
from torch_port_helpers import cpu_place


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _close(got, want, tol, what):
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs " \
                                    f"{want.shape}"
    assert str(got.dtype) == str(want.dtype), \
        f"{what}: dtype {got.dtype} vs {want.dtype}"
    kind = np.complex128 if got.dtype.kind == "c" else np.float64
    np.testing.assert_allclose(got.astype(kind), np.asarray(want, kind),
                               rtol=tol, atol=tol, err_msg=what)


# the long-tail cases run in tests/test_torch_longtail.py, incubate's in
# tests/test_torch_incubate_functional.py, the op surfaces' in
# tests/test_torch_fft_signal.py, test_torch_geometric.py and
# test_torch_quantization.py
_CASES = [c for c in C.CASES
          if c[0] not in set(C.LONGTAIL_CASES) | set(C.INCUBATE_CASES)
          | set(C.OPSURF_CASES)]


@pytest.mark.parametrize("name,fn,opts", _CASES, ids=[c[0] for c in _CASES])
def test_op_matches_reference(name, fn, opts):
    check_case(name, fn, opts)


def check_case(name, fn, opts):
    """One case of eager_op_cases.py on both packages, held by this
    file's rule."""
    grad = opts.get("grad", True)
    got, got_g = C.run_case(ptt, fn, grad=grad)
    want, want_g = C.run_case(pt, fn, grad=grad)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, np.asarray(w), opts.get("tol", 1e-6), f"{name} out {i}")
    for i in set(got_g) | set(want_g):
        if i not in got_g:
            assert not np.asarray(want_g[i], np.float64).any(), \
                f"{name}: the reference has a nonzero grad of input {i}"
            continue
        assert i in want_g, f"{name}: the port has a grad of input {i}"
        _close(got_g[i], np.asarray(want_g[i]), opts.get("grad_tol", 1e-5),
               f"{name} grad {i}")


def test_every_op_of_the_table_has_a_case():
    """Each op of the port's OPS table is dispatched by some case."""
    from paddle_tpu_torch.ops import registry
    seen = set()
    real = registry.dispatch

    def spy(opdef, args, kwargs):
        seen.add(opdef.name)
        return real(opdef, args, kwargs)

    registry.dispatch = spy
    try:
        for _name, fn, opts in C.CASES:
            C.run_case(ptt, fn, grad=opts.get("grad", True))
    finally:
        registry.dispatch = real
    assert not sorted(set(OPS) - seen)


def test_torch_level_calls_skip_the_dispatch():
    """The models, the engine and TrainStep call the registered nn ops
    with torch tensors: such a call runs the function itself (no
    dispatch, no wrap, no second AMP cast) and returns what it
    returns."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import registry
    x, w, b = torch.randn(4, 8), torch.randn(8, 3), torch.randn(3)
    before = registry.dispatch_count()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = F.linear(x, w, b)
        want = F.linear.raw_fn(x, w, b)
        ln = F.layer_norm(got, None, None)
    assert registry.dispatch_count() == before
    assert type(got) is torch.Tensor and got.dtype == torch.bfloat16
    # layer_norm is AMP-black: its own cast, once, to f32
    assert torch.equal(got, want) and ln.dtype == torch.float32
    t = F.linear(ptt.to_tensor(x.numpy()), ptt.to_tensor(w.numpy()),
                 ptt.to_tensor(b.numpy()))
    assert registry.dispatch_count() == before + 1
    assert isinstance(t, ptt.Tensor) and torch.equal(
        t._data, F.linear.raw_fn(x, w, b))


def test_torch_level_calls_with_lists_skip_the_dispatch():
    """A registered op whose torch tensors come in a list (concat, stack,
    the stacks of the long tail) runs torch-level too: the zoo's
    DenseNet, SqueezeNet, ShuffleNetV2, GoogLeNet and InceptionV3 concat
    their branches so, and got the eager API's Tensors back before."""
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import registry
    a, b = torch.randn(2, 3), torch.randn(2, 3)
    before = registry.dispatch_count()
    for got in (ops.concat([a, b], axis=1), ops.stack((a, b)),
                ops.hstack([a, b]), ops.block_diag([a, b])):
        assert type(got) is torch.Tensor
    assert registry.dispatch_count() == before
    t = ops.concat([ptt.to_tensor(a.numpy()), ptt.to_tensor(b.numpy())])
    assert isinstance(t, ptt.Tensor)
    assert registry.dispatch_count() == before + 1
    from paddle_tpu_torch.vision.models import squeezenet1_1
    m = squeezenet1_1(num_classes=10, device="cpu").eval()
    with torch.no_grad():
        assert type(m(torch.randn(1, 3, 32, 32))) is torch.Tensor
