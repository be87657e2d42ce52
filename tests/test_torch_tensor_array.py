"""paddle_tpu_torch.tensor_array against paddle_tpu.tensor_array on the
CPU: the same writes, reads, lengths and stacks on both packages, and
the same errors."""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_helpers import cpu_place


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _script(P):
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(3)]
    arr = P.create_array("float32", [vals[0]])
    assert isinstance(arr[0], P.Tensor)
    i = P.to_tensor(np.array(1, np.int32))
    P.array_write(P.to_tensor(vals[1]), i, arr)
    P.array_write(P.to_tensor(vals[2]), 2, arr)
    P.array_write(P.to_tensor(vals[0] * 2), 0, arr)
    fresh = P.array_write(P.to_tensor(vals[1]), 0)
    out = [P.array_read(arr, 1).numpy(), P.array_read(arr, i).numpy(),
           P.array_length(arr).numpy(), P.array_length(fresh).numpy(),
           arr.stack(axis=1).numpy(), arr.concat().numpy()]
    with pytest.raises(IndexError):
        P.array_write(P.to_tensor(vals[0]), 5, arr)
    return out


def test_tensor_array_matches_reference():
    got, want = _script(ptt), _script(pt)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_names_are_exported_at_the_root():
    from paddle_tpu_torch import tensor_array
    for n in ("create_array", "array_write", "array_read", "array_length"):
        assert getattr(ptt, n) is getattr(tensor_array, n)
    assert issubclass(tensor_array.TensorArray, list)
