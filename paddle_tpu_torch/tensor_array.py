"""TensorArray (counterpart of paddle_tpu/tensor_array.py): a Python
list of Tensors with the reference's array semantics for eager code,
and its four functions ``create_array``, ``array_write``,
``array_read`` and ``array_length``."""
from __future__ import annotations

from . import ops
from .core.tensor import Tensor

__all__ = ["TensorArray", "create_array", "array_write", "array_read",
           "array_length"]


class TensorArray(list):
    """A list of Tensors with the reference's array semantics."""

    def stack(self, axis=0):
        return ops.stack(list(self), axis=axis)

    def concat(self, axis=0):
        return ops.concat(list(self), axis=axis)


def create_array(dtype="float32", initialized_list=None):
    arr = TensorArray()
    for t in initialized_list or ():
        arr.append(t if isinstance(t, Tensor) else Tensor(t))
    return arr


def _index(i):
    if isinstance(i, Tensor):
        return int(i.numpy())
    return int(i)


def array_write(x, i, array=None):
    """x written at index i, growing the array by one at its end."""
    if array is None:
        array = create_array()
    i = _index(i)
    if i < len(array):
        array[i] = x
    elif i == len(array):
        array.append(x)
    else:
        raise IndexError(
            f"array_write index {i} beyond array length {len(array)}")
    return array


def array_read(array, i):
    return array[_index(i)]


def array_length(array):
    return Tensor(len(array))
